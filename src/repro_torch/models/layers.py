"""Core transformer layers: RMSNorm, RoPE, attention (GQA + sliding
window) and the SwiGLU/GELU MLP.

The counterpart of ``repro/models/layers.py``, with its casts: float32
inside rms_norm, rope and the activations, then back to the stream dtype.
Train and prefill attention go to the flash attention op (K2 on the
card, its plain version on the CPU) with KV heads unexpanded; the op's
backward differentiates ``chunk_attention``, one query chunk of the
reference's blockwise scan in plain torch.  Decode attends a KV cache
with position masking.  ``moe_apply`` waits for the MoE slice.
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
                    causal: bool = True, window: int | None = None,
                    q_chunk: int = 1024,
                    kv_chunk: int = 1024) -> torch.Tensor:
    """q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd), KV heads unexpanded ->
    (B, S, Hq, hd).  At ``tp = 1`` query head h reads KV head h // G,
    which is the reference's ``kv_map`` expansion.  The chunks are those
    of the backward's blockwise recompute."""
    return flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                     q_chunk=q_chunk, kv_chunk=kv_chunk)


def key_range(q0: int, q1: int, T: int, *, causal: bool,
              window: int | None, kv_chunk: int) -> tuple[int, int]:
    """The keys ``[lo, hi)`` that queries ``[q0, q1)`` may attend, widened
    to whole ``kv_chunk`` blocks counted from key 0 (so a chunk of queries
    sees the same key blocks as in the whole scan)."""
    lo = 0 if window is None else max(0, q0 - window + 1)
    hi = min(T, q1) if causal else T
    lo = lo // kv_chunk * kv_chunk
    hi = min(T, -(-hi // kv_chunk) * kv_chunk)
    return lo, hi


def chunk_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q0: int, k0: int, *, causal: bool, window: int | None,
                    kv_chunk: int, scale: float) -> torch.Tensor:
    """One query chunk's online softmax over the keys it is given, in
    float32: q (B, n, Hq, hd) at positions ``q0 + i``; k, v (B, m, Hkv,
    hd) at ``k0 + j``, KV heads unexpanded (query head h reads KV head
    h // G), visited ``kv_chunk`` keys at a time -> (B, n, Hq, hd)
    float32."""
    B, n, Hq, hd = q.shape
    m_keys, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qb = q.float().reshape(B, n, Hkv, G, hd)
    q_pos = q0 + torch.arange(n, device=q.device)
    m = torch.full((B, Hkv, G, n), NEG_INF, device=q.device)
    denom = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, n, hd), device=q.device)
    for j0 in range(0, m_keys, kv_chunk):
        j1 = min(m_keys, j0 + kv_chunk)
        k_pos = k0 + torch.arange(j0, j1, device=q.device)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, k[:, j0:j1].float()) * scale
        mask = torch.ones((n, j1 - j0), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= (q_pos[:, None] - k_pos[None, :]) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        denom = denom * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p, v[:, j0:j1].float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp(denom, min=1e-20)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, n, Hq, hd)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int | None = None,
                        q_chunk: int = 1024, kv_chunk: int = 1024,
                        scale: float | None = None) -> torch.Tensor:
    """The reference's blockwise (flash-style) attention in plain torch:
    per query chunk an online softmax over key chunks, in float32.

    q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd), KV heads unexpanded (query
    head h reads KV head h // G) -> (B, S, Hq, hd) in q's dtype.  A query
    chunk visits only the key chunks that causality and the window leave
    it (``key_range``; the reference visits every chunk, and a fully
    masked one adds nothing), and keys are masked by their true length,
    so nothing is padded.
    """
    S, T, hd = q.shape[1], k.shape[1], q.shape[3]
    scale = 1.0 / np.sqrt(hd) if scale is None else scale
    outs = []
    for q0 in range(0, S, q_chunk):
        q1 = min(S, q0 + q_chunk)
        lo, hi = key_range(q0, q1, T, causal=causal, window=window,
                           kv_chunk=kv_chunk)
        outs.append(chunk_attention(
            q[:, q0:q1], k[:, lo:hi], v[:, lo:hi], q0, lo, causal=causal,
            window=window, kv_chunk=kv_chunk, scale=scale))
    return torch.cat(outs, dim=1).to(q.dtype)


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
