"""Core transformer layers: RMSNorm, RoPE, attention (GQA + sliding
window) and the SwiGLU/GELU MLP.

The counterpart of ``repro/models/layers.py``, with its casts: float32
inside rms_norm, rope and the activations, then back to the stream dtype.
Train and prefill attention go to the flash attention op (K2 on the
card, its plain version on the CPU) with KV heads unexpanded; the op's
backward is K2-bwd on the card and its plain version on the CPU.
``blockwise_attention`` is the reference's blockwise scan in plain torch.
Decode attends a KV cache
with position masking.  ``moe_apply`` routes each token to its top-k
experts by the reference's block-local sort-based capacity dispatch, the
experts split over the model axis' ranks (``moe_experts``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.embedding.sharded import _AllToAll
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
    (B, S, Hq, hd).  Query head h reads KV head h // G, the reference's
    ``kv_map`` expansion where no head is padded (``LM._attend`` expands
    the KV heads first where the map differs).  ``q_chunk`` is the plain
    backward's block of queries (the CPU's)."""
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


def expand_kv(k: torch.Tensor, v: torch.Tensor,
              heads: np.ndarray) -> tuple[torch.Tensor, torch.Tensor]:
    """k, v (B, T, Hkv, hd) as query head h reads them, through KV head
    ``heads[h]``: as they are where that is ``h // G``, else gathered
    through ``heads`` (B, T, Hq, hd), one KV head a query head."""
    nq, nk = len(heads), k.shape[2]
    if nq % nk == 0 and np.array_equal(heads, np.arange(nq) // (nq // nk)):
        return k, v
    idx = torch.as_tensor(heads, device=k.device)
    return k[:, :, idx], v[:, :, idx]


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, valid_mask: torch.Tensor,
                             heads: np.ndarray, group=None) -> torch.Tensor:
    """Single-token attention over a cache, query head h reading KV head
    ``heads[h]`` (``expand_kv``).  With ``group`` the cache is one rank's
    slice of the keys, and the softmax is one flash-decoding pass: the
    running max all-reduced (MAX) over the group, then ``sum p`` and
    ``sum p v`` with ``p = exp(s - max)`` all-reduced (SUM), so every rank
    gets the whole softmax.

    q: (B, 1, Hq, hd); caches: (B, T, Hkv, hd); valid_mask: (B, T) bool
    -> (B, 1, Hq, hd) in q's dtype.
    """
    B, _, Hq, hd = q.shape
    k_cache, v_cache = expand_kv(k_cache, v_cache, heads)
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    qr = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache.float()) * (
        1.0 / np.sqrt(hd))
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    if group is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
        return out.reshape(B, 1, Hq, hd).to(q.dtype)
    m = s.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    dist.all_reduce(den, group=group)
    dist.all_reduce(acc, group=group)
    return (acc / den).reshape(B, 1, Hq, hd).to(q.dtype)


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


# ---- sort-based MoE -------------------------------------------------------------

class MoERouting(NamedTuple):
    """One ``moe_apply`` call's routing.  Per (example, sequence chunk)
    block of ``Sn`` tokens, ``NK = Sn * top_k`` slots are packed into
    ``EC = n_experts * cap`` expert rows as the reference packs them.

    ``probs`` (B, S, E) float32; ``top_e``/``top_w`` (B, S, K); ``tok_buf``
    (B, n, EC), each expert row's token in its block (``Sn`` where the row
    is empty); ``w_buf`` (B, n, EC) its weight in ``x``'s dtype (0 where
    empty); ``slot`` (B, n, NK), the expert row of token ``t``'s ``k``-th
    choice at ``t * K + k`` (``EC`` where capacity dropped it).
    """
    probs: torch.Tensor
    top_e: torch.Tensor
    top_w: torch.Tensor
    tok_buf: torch.Tensor
    w_buf: torch.Tensor
    slot: torch.Tensor
    cap: int

    def dropped_share(self) -> float:
        """The share of the block's slots that capacity dropped."""
        return float((self.slot == self.tok_buf.shape[-1]).float().mean())


def _blocks(S: int, seq_chunks: int) -> int:
    """The reference's sequence chunk count: ``seq_chunks`` halved until
    it divides ``S``."""
    n = max(1, seq_chunks)
    while S % n:
        n //= 2
    return n


def moe_route(x: torch.Tensor, router: torch.Tensor, *, n_experts: int,
              top_k: int, capacity_factor: float,
              seq_chunks: int = 1) -> MoERouting:
    """The reference's router and block-local sort-based capacity
    dispatch (``repro/models/layers.py:154-197``).

    The router product is float32 (the leaf is float32; JAX promotes a
    bf16 ``x``), and must not run in TF32, which would flip routes.
    ``top_k`` is a stable descending sort, so ties go to the lower
    expert, as ``lax.top_k`` breaks them."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError("the MoE router is float32: turn TF32 off "
                         "(torch.backends.cuda.matmul.allow_tf32 = False)")
    B, S, _ = x.shape
    n = _blocks(S, seq_chunks)
    Sn = S // n
    NK = Sn * top_k
    cap = int(np.ceil(capacity_factor * NK / n_experts))
    EC = n_experts * cap

    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[..., :top_k], top_e[..., :top_k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)

    fe = top_e.reshape(B, n, NK)
    sorted_e, order = torch.sort(fe, dim=-1, stable=True)
    experts = torch.arange(n_experts, device=x.device)
    group_start = torch.searchsorted(
        sorted_e, experts.expand(B, n, n_experts).contiguous())
    pos = torch.arange(NK, device=x.device) - torch.gather(
        group_start, -1, sorted_e)
    dest = torch.where(pos < cap, sorted_e * cap + pos, EC)
    tok_of_slot = torch.arange(NK, device=x.device) // top_k
    tok_buf = torch.full((B, n, EC + 1), Sn, dtype=torch.long,
                         device=x.device).scatter(-1, dest,
                                                  tok_of_slot[order])
    w_buf = torch.zeros((B, n, EC + 1), dtype=x.dtype,
                        device=x.device).scatter(
        -1, dest, torch.gather(top_w.reshape(B, n, NK), -1,
                               order).to(x.dtype))
    slot = torch.empty_like(dest).scatter_(-1, order, dest)
    return MoERouting(probs, top_e, top_w, tok_buf[..., :EC],
                      w_buf[..., :EC], slot, cap)


def expert_major(r: MoERouting, t: torch.Tensor) -> torch.Tensor:
    """A per-block expert-row tensor (B, n, EC, ...) laid out expert by
    expert over every block: row ``(block, e * cap + c)`` at ``e * M +
    block * cap + c``, with ``M = B * n * cap`` rows an expert -> (E * M,
    ...)."""
    B, n, EC = t.shape[:3]
    E = EC // r.cap
    t = t.reshape(B * n, E, r.cap, *t.shape[3:]).transpose(0, 1)
    return t.reshape(EC * B * n, *t.shape[3:])


def expert_rows(r: MoERouting) -> tuple[torch.Tensor, torch.Tensor]:
    """``r``'s maps in ``expert_major``'s layout over the stream of ``T =
    B * S`` tokens: ``tok`` (R,), each expert row's token (``T`` where
    the row is empty), and ``slots`` (T, K), each token's expert rows in
    ascending order (``R`` for a choice that capacity dropped)."""
    B, n, EC = r.tok_buf.shape
    K = r.top_e.shape[-1]
    Sn, M = r.slot.shape[-1] // K, B * n * r.cap
    T, R = B * n * Sn, B * n * EC
    blk = torch.arange(B * n, device=r.slot.device).reshape(B, n, 1)
    tok = torch.where(r.tok_buf < Sn, r.tok_buf + blk * Sn, T)
    rows = r.slot // r.cap * M + blk * r.cap + r.slot % r.cap
    slots = torch.where(r.slot < EC, rows, R).reshape(T, K)
    return expert_major(r, tok), torch.sort(slots, dim=-1).values


def _padded(src: torch.Tensor) -> torch.Tensor:
    """``src`` (N, D) with a zero row appended at index N."""
    zero = torch.zeros((1, src.shape[1]), dtype=src.dtype, device=src.device)
    return torch.cat([src, zero])


def _gather_rows(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``src``'s rows at ``index``; ``len(src)`` reads a zero row."""
    return _padded(src)[index]


def _ordered_sum(rows: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """``out[t] = 0 + rows[slots[t, 0]] + rows[slots[t, 1]] + ...``, one
    add at a time in ``rows``' dtype (``len(rows)`` adds nothing): K
    gather-and-add passes, with no atomics."""
    rows = _padded(rows)
    out = torch.zeros((slots.shape[0], rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    for k in range(slots.shape[1]):
        out += rows[slots[:, k]]
    return out


class _Dispatch(torch.autograd.Function):
    """Token rows to expert rows, ``x[tok]``; the backward sums each
    token's rows by ``_ordered_sum``, the reference's scatter-add order."""

    @staticmethod
    def forward(ctx, x, tok, slots):
        ctx.save_for_backward(slots)
        return _gather_rows(x, tok)

    @staticmethod
    def backward(ctx, g):
        (slots,) = ctx.saved_tensors
        return _ordered_sum(g, slots), None, None


class _Combine(torch.autograd.Function):
    """Expert rows to token rows by ``_ordered_sum``; the backward is the
    gather ``g[tok]``."""

    @staticmethod
    def forward(ctx, rows, slots, tok):
        ctx.save_for_backward(tok)
        return _ordered_sum(rows, slots)

    @staticmethod
    def backward(ctx, g):
        (tok,) = ctx.saved_tensors
        return _gather_rows(g, tok), None, None


def _all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group``, concatenated along dim 0 in the
    group's rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _own_chunk(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's chunk of ``t`` split evenly along dim 0 over ``group``."""
    m = dist.get_world_size(group)
    return t.chunk(m)[dist.get_rank(group)]


class _OwnExperts(torch.autograd.Function):
    """This rank's contiguous chunk of the expert grid (E, M, D) -> (E / m,
    M, D) of a grid that every rank of ``group`` holds whole; the backward
    gathers the chunks' gradients, so every rank gets the whole grid's."""

    @staticmethod
    def forward(ctx, grid, group):
        ctx.group = group
        return _own_chunk(grid, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group), None


class _AllExperts(torch.autograd.Function):
    """The transpose of ``_OwnExperts``: every rank's chunk of expert rows
    gathered in expert order; the backward keeps this rank's chunk of a
    gradient that every rank holds whole."""

    @staticmethod
    def forward(ctx, rows, group):
        ctx.group = group
        return _all_gather(rows, group)

    @staticmethod
    def backward(ctx, g):
        return _own_chunk(g, ctx.group), None


def _to_experts(grid: torch.Tensor, group) -> torch.Tensor:
    """The all-to-all into the experts: this rank's rows of every expert,
    (E, M, D), out as expert group ``j`` (``E / m`` contiguous experts) to
    rank ``j``; in, every rank's rows of this rank's experts, (E / m, m *
    M, D), rank by rank."""
    m = dist.get_world_size(group)
    E, M, D = grid.shape
    got = _AllToAll.apply(grid.reshape(m, E // m, M, D), group)
    return got.transpose(0, 1).reshape(E // m, m * M, D)


def _from_experts(out: torch.Tensor, group) -> torch.Tensor:
    """The inverse of ``_to_experts``: (E / m, m * M, D) -> this rank's
    rows of every expert, (E, M, D)."""
    m = dist.get_world_size(group)
    E_loc, mM, D = out.shape
    sent = out.reshape(E_loc, m, mM // m, D).transpose(0, 1)
    return _AllToAll.apply(sent, group).reshape(m * E_loc, mM // m, D)


def _expert_ffn(params: dict, grid: torch.Tensor, act: str) -> torch.Tensor:
    """The experts' MLP, one batched matmul an expert weight: grid (E, R,
    D) -> (E, R, D)."""
    if act == "swiglu":
        gate = torch.bmm(grid, params["wg"])
        up = torch.bmm(grid, params["wu"])
        h = F.silu(gate.float()).to(grid.dtype) * up
    else:
        h = torch.bmm(grid, params["wu"])
        h = F.gelu(h.float(), approximate="tanh").to(grid.dtype)
    return torch.bmm(h, params["wo"])


def moe_experts(params: dict, x: torch.Tensor, r: MoERouting, *, act: str,
                group=None, replicated: bool = False) -> torch.Tensor:
    """``x`` (B, S, D) through the experts by ``r``, its routing ->
    (B, S, D) in x's dtype.  ``params``: ``wg``/``wu`` (E / m, D, F) and
    ``wo`` (E / m, F, D), this rank's contiguous share of the E experts,
    ``m`` the size of ``group`` (the model axis' ranks; all E experts and
    no exchange where it is None).

    The expert rows are laid out expert by expert over every block (E, B
    * n * cap, D) for batched matmuls.  Expert parallelism, as the
    reference's GSPMD places it:

    * all-to-all (``replicated`` False): ``x`` is this rank's own blocks
      (its slice of the sequence); its rows of expert group ``j`` go to
      rank ``j`` and the experts' outputs come back the same way;
    * replicated (``replicated`` True, where the blocks do not split
      over the ranks: a decode step's one block over two or more): every
      rank holds ``x`` and the routing whole, runs its own experts' slice
      of the grid and gathers every rank's outputs.

    Either way each token's rows come back to the rank that routed them,
    and the combine adds them there in ascending slot order, rounding
    after every add, as the reference's bf16 scatter-add does and as one
    device does: a partial sum over ranks would add them in another order
    and change the bits.  No ``index_add_`` and no atomics, so it is
    deterministic, and its backward (a gather) and the dispatch's (the
    same ordered sum) are too."""
    B, S, D = x.shape
    tok, slots = expert_rows(r)
    grid = _Dispatch.apply(x.reshape(B * S, D), tok, slots)
    grid = grid.reshape(r.probs.shape[-1], -1, D)
    if group is None:
        out = _expert_ffn(params, grid, act)
    elif replicated:
        out = _AllExperts.apply(_expert_ffn(
            params, _OwnExperts.apply(grid, group), act), group)
    else:
        out = _from_experts(_expert_ffn(params, _to_experts(grid, group),
                                        act), group)
    y = _Combine.apply(out.reshape(-1, D) * expert_major(r, r.w_buf)[:, None],
                       slots, tok)
    return y.reshape(B, S, D)


def moe_apply(params: dict, x: torch.Tensor, *, n_experts: int, top_k: int,
              capacity_factor: float, act: str,
              seq_chunks: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k routed MoE with block-local sort-based capacity dispatch, the
    counterpart of the reference's ``moe_apply``
    (``repro/models/layers.py:154-235``) on one device: ``moe_route``,
    ``moe_experts`` with every expert and no exchange, then the
    load-balance loss.  ``LM`` runs the same three steps on each rank
    with the experts split over the model axis: the all-to-all or the
    replicated case by whether the sequence's blocks split over the
    ranks, and the combine in one-device slot order on the rank that
    routed (``moe_experts``), the loss's two factors summed over every
    rank's tokens (``moe_balance_terms``).

    x: (B, S, D) -> (y (B, S, D) in x's dtype, the load-balance loss, a
    float32 scalar).  ``params``: ``router`` (D, E) float32, ``wg``/``wu``
    (E, D, F) and ``wo`` (E, F, D)."""
    B, S, D = x.shape
    r = moe_route(x, params["router"], n_experts=n_experts, top_k=top_k,
                  capacity_factor=capacity_factor, seq_chunks=seq_chunks)
    y = moe_experts(params, x, r, act=act)
    aux = moe_load_balance_loss(r.probs.reshape(B * S, n_experts),
                                r.top_e.reshape(B * S, top_k), n_experts)
    return y, aux


def moe_balance_terms(probs: torch.Tensor, top_e: torch.Tensor,
                      n_experts: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The load-balance loss's two factors over T tokens (probs (T, E),
    top_e (T, K)): the share of the tokens whose first choice is each
    expert, and each expert's mean router probability, (E,) float32
    each."""
    frac_routed = F.one_hot(top_e[:, 0], n_experts).float().mean(dim=0)
    return frac_routed, probs.mean(dim=0)


def moe_load_balance_loss(probs: torch.Tensor, top_e: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balance auxiliary loss (float32): ``E`` x the sum
    over experts of the share of tokens whose first choice it is, times
    its mean router probability."""
    frac_routed, mean_prob = moe_balance_terms(probs, top_e, n_experts)
    return n_experts * (frac_routed * mean_prob).sum()
