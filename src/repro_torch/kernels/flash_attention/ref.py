"""Plain PyTorch versions of flash attention (K2) and of its backward
(K2-bwd): materialized softmax.

``attention_plain`` is the counterpart of
``repro/kernels/flash_attention/ref.py``, in the ``(B, S, H, hd)`` layout
of the port's op, with grouped KV heads (query head ``h`` reads KV head
``h // (Hq // Hkv)``) and an explicit ``scale``.  Keys are masked by their
true length ``T``.  It loops over the batch so that one ``(Hq, S, T)``
score matrix is alive at a time.  ``attention_bwd_plain`` repeats
K2-bwd's arithmetic from the forward's output and row log-sum-exp.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_mask(S: int, T: int, *, causal: bool, window: int | None,
                   device=None) -> torch.Tensor:
    """(S, T) bool, True where query ``q`` may attend key ``k``."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(T, device=device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window is not None:
        mask &= (qp - kp) < window
    return mask


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None, lse: bool = False):
    """q: (B, S, Hq, hd); k, v: (B, T, Hkv, hd) with Hq % Hkv == 0 ->
    (B, S, Hq, hd) in q's dtype, computed in float32 (float64 for float64
    inputs).  With ``lse`` also each row's log-sum-exp of the masked,
    scaled scores, (B, Hq, S) in that precision, as K2 gives it; the
    output is the same either way."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    ct = _compute_dtype(q)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    mask = attention_mask(S, T, causal=causal, window=window,
                          device=q.device)
    out = torch.empty_like(q)
    rows = torch.empty((B, Hq, S), dtype=ct, device=q.device) if lse \
        else None
    for b in range(B):
        qb = q[b].to(ct).transpose(0, 1)                         # (Hq, S, hd)
        kb = k[b].to(ct).repeat_interleave(Hq // Hkv, dim=1).transpose(0, 1)
        vb = v[b].to(ct).repeat_interleave(Hq // Hkv, dim=1).transpose(0, 1)
        s = torch.matmul(qb, kb.transpose(1, 2)) * scale         # (Hq, S, T)
        s = torch.where(mask, s, NEG_INF)
        if lse:
            rows[b] = torch.logsumexp(s, dim=-1)
        p = torch.softmax(s, dim=-1)
        out[b] = torch.matmul(p, vb).transpose(0, 1).to(q.dtype)
    return (out, rows) if lse else out


def attention_bwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: int | None = None,
                        scale: float | None = None, q_chunk: int = 1024):
    """K2-bwd's arithmetic (FA2's backward) in float32 (float64 for
    float64 inputs), one chunk of ``q_chunk`` queries at a time over the
    keys it may attend, with no autograd:

        P = exp(q k^T scale - lse) (0 where the mask forbids),
        D = rowsum(dout * out), dS = P (dout v^T - D),
        dq = dS k scale, dk = dS^T q scale, dv = P^T dout,

    dk and dv summed over the query heads of their group.  q, out, dout:
    (B, S, Hq, hd); k, v: (B, T, Hkv, hd); lse: (B, Hq, S) from the
    forward (``attention_plain(..., lse=True)`` or K2's) -> (dq, dk, dv)
    in the inputs' dtype.  One chunk's ``(B, Hq, q_chunk, keys)`` scores
    are alive at a time, over the keys some query of the chunk may
    attend.  A row with no valid key (where S > T + window) gets zero
    gradients, as from K2-bwd."""
    B, S, Hq, hd = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    ct = _compute_dtype(q)
    scale = 1.0 / math.sqrt(hd) if scale is None else scale
    dq = torch.empty_like(q)
    dk = torch.zeros((B, T, Hkv, hd), dtype=ct, device=k.device)
    dv = torch.zeros_like(dk)
    kf = k.to(ct).permute(0, 2, 1, 3)                     # (B, Hkv, T, hd)
    vf = v.to(ct).permute(0, 2, 1, 3)
    full_mask = attention_mask(S, T, causal=causal, window=window,
                               device=q.device)
    for q0 in range(0, S, q_chunk):
        q1 = min(S, q0 + q_chunk)
        lo = 0 if window is None else max(0, q0 - window + 1)
        hi = min(T, q1) if causal else T
        n = q1 - q0
        # (B, Hkv, G, n, hd) query chunks; (B, Hkv, 1, m, hd) keys
        qc = q[:, q0:q1].to(ct).reshape(B, n, Hkv, G, hd).permute(
            0, 2, 3, 1, 4)
        oc = out[:, q0:q1].to(ct).reshape(B, n, Hkv, G, hd).permute(
            0, 2, 3, 1, 4)
        gc = dout[:, q0:q1].to(ct).reshape(B, n, Hkv, G, hd).permute(
            0, 2, 3, 1, 4)
        kc, vc = kf[:, :, None, lo:hi], vf[:, :, None, lo:hi]
        mask = full_mask[q0:q1, lo:hi]
        s = (qc @ kc.transpose(-1, -2)) * scale               # (B,Hkv,G,n,m)
        p = torch.where(mask, torch.exp(s - lse[:, :, q0:q1].to(ct).reshape(
            B, Hkv, G, n)[..., None]), 0.0)
        delta = (gc * oc).sum(-1, keepdim=True)
        ds = p * (gc @ vc.transpose(-1, -2) - delta)
        dq[:, q0:q1] = ((ds @ kc) * scale).permute(0, 3, 1, 2, 4).reshape(
            B, n, Hq, hd).to(q.dtype)
        dk[:, lo:hi] += ((ds.transpose(-1, -2) @ qc).sum(2) * scale
                         ).transpose(1, 2)
        dv[:, lo:hi] += (p.transpose(-1, -2) @ gc).sum(2).transpose(1, 2)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def _compute_dtype(q: torch.Tensor) -> torch.dtype:
    return torch.float64 if q.dtype == torch.float64 else torch.float32
