"""Decoder-only LM: the dense decoders (h2o-danube-1.8b, qwen2.5-14b,
phi4-mini-3.8b, granite-34b), the MoE ones (olmoe-1b-7b, dbrx-132b),
hymba's hybrid block (hymba-1.5b), RWKV-6 (rwkv6-1.6b) and the frontend
archs (llava-next-34b, musicgen-large).

The counterpart of ``repro/models/transformer.py`` at ``tp = 1``: GQA
and MQA, QKV biases, tied embeddings, top-k routed
experts (``layers.moe_apply``) in place of the MLP, whose load-balance
losses ``forward`` and ``forward_loss`` return averaged over the layers;
``block="hybrid"`` adds a selective SSM (``ssm.ssm_apply``) to attention
on the same normed input; ``block="rwkv"`` is RWKV-6 time mixing, then
channel mixing, with no attention.  Parameters are a nested dict of
tensors in the reference's pytree layout, with each layer's weights
stacked along a leading ``L`` axis; the layer loop is a Python loop over
that axis (the reference's ``layer_loop="unrolled"``), each layer under
``torch.utils.checkpoint`` when ``remat`` is on and autograd records.
A frontend arch's encoder is a stub, as in the reference: ``forward``,
``forward_loss`` and ``prefill`` take precomputed ``embeds`` (B, F, D),
cast to the model's dtype and put in front of the token embeddings
(``_embed``); the positions, the labels, the loss mask and the cache
count the frames too.  ``decode_step`` embeds tokens only.

Entry points:
  * ``forward``      -- train/eval logits over a full sequence
  * ``forward_loss`` -- the chunked cross-entropy, with no ``(B, S, Vp)``
    logits
  * ``prefill``      -- forward + a populated cache
  * ``decode_step``  -- one token against the (circular) cache

Train and prefill attention run through the flash attention op with KV
heads unexpanded (K2 on the card; its backward recomputes the blockwise
scan in ``q_chunk``/``kv_chunk`` blocks); the SSM's and RWKV's scans
over time run through K3 and K4 on the card, and their backward through
K3-bwd and K4-bwd (under ``remat`` each layer's scan runs again in the
backward, with the same bits).  The cache (KV, and the
SSM's state and conv carry, or RWKV's WKV state and token-shift rows) is
updated in place: ``prefill`` allocates it and ``decode_step`` writes its
token into the tensors it is given, returning them with ``pos`` advanced.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models.config import ArchConfig


class ParamSpec(NamedTuple):
    """One leaf of ``LM.param_layout``: its shape and dtype, and how
    ``init_params`` fills it: ``"normal"`` (x ``value``), ``"full"`` (at
    ``value``) or ``"log_range"`` (log(1..N) along the last axis)."""
    shape: tuple
    dtype: torch.dtype
    init: str
    value: float = 0.0


class LM:
    def __init__(self, cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device | None = None,
                 remat: bool = True, q_chunk: int = 1024,
                 kv_chunk: int = 1024):
        if cfg.tp != 1 or not cfg.head_dim:
            raise ValueError("config must be resolve(1)d: the port runs "
                             "unsharded (sharding is on the ROADMAP queue)")
        if cfg.block not in ("attn", "hybrid", "rwkv"):
            raise ValueError(f"{cfg.name}: unknown block {cfg.block!r}")
        if cfg.block != "rwkv" and (cfg.n_heads_padded != cfg.n_heads
                                    or cfg.n_heads % cfg.n_kv_heads):
            raise NotImplementedError(
                f"{cfg.name}: query heads must group evenly over KV heads")
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.remat = remat
        self.q_chunk = q_chunk
        self.kv_chunk = kv_chunk

    # ---- parameters ----------------------------------------------------------

    def param_layout(self) -> dict:
        """The parameter tree, each leaf a ``ParamSpec`` (shape, dtype and
        how ``init_params`` draws it), allocating nothing: shapes as in
        the reference (no ``lm_head`` with tied embeddings; QKV biases at
        zero; on MoE layers a float32 ``router`` and stacked experts in
        place of the ``mlp``; on hybrid layers an ``ssm`` subtree with
        ``conv`` at 0.2, ``logA = log(1..N)`` in float32 and ``dskip`` at
        1; on RWKV layers the ``ln1``/``ln2``/``rwkv`` layout, ``mu`` and
        ``u`` at 0.5 and ``w_bias`` at -6 in float32), every other weight
        normal x 0.02 and every norm at 1."""
        cfg, dt = self.cfg, self.dtype
        n, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff

        def normal(*shape, scale=0.02, dtype=dt):
            return ParamSpec(shape, dtype, "normal", scale)

        def full(*shape, value=1.0, dtype=dt):
            return ParamSpec(shape, dtype, "full", value)

        params = {"embed": normal(cfg.vocab_padded, d), "final_norm": full(d)}
        if not cfg.tie_embeddings:
            params["lm_head"] = normal(d, cfg.vocab_padded)
        lay = params["layers"] = {"ln1": full(n, d), "ln2": full(n, d)}
        if cfg.block == "rwkv":
            H = d // SSM.RWKV_HEAD_DIM
            lay["rwkv"] = {
                "att": {"mu": normal(n, 5, d, scale=0.5),
                        **{w: normal(n, d, d) for w in
                           ("wr", "wk", "wv", "wg", "ww", "wo")},
                        "w_bias": full(n, d, value=-6.0,
                                       dtype=torch.float32),
                        "u": normal(n, H, SSM.RWKV_HEAD_DIM, scale=0.5)},
                "ffn": {"mu": normal(n, 2, d, scale=0.5),
                        "wk": normal(n, d, f), "wv": normal(n, f, d),
                        "wr": normal(n, d, d)}}
            return params
        hd, Hq, Hkv = cfg.head_dim, cfg.n_heads_padded, cfg.n_kv_heads
        lay.update({"wq": normal(n, d, Hq * hd), "wk": normal(n, d, Hkv * hd),
                    "wv": normal(n, d, Hkv * hd),
                    "wo": normal(n, Hq * hd, d)})
        if cfg.qkv_bias:
            for b, width in (("bq", Hq * hd), ("bk", Hkv * hd),
                             ("bv", Hkv * hd)):
                lay[b] = full(n, width, value=0.0)
        if cfg.block == "hybrid":
            di, N = cfg.ssm.expand * d, cfg.ssm.state_dim
            lay["ssm"] = {"in_proj": normal(n, d, 2 * di),
                          "conv": normal(n, cfg.ssm.conv_width, di,
                                         scale=0.2),
                          "wdt": normal(n, di),
                          "wB": normal(n, di, N), "wC": normal(n, di, N),
                          "logA": ParamSpec((n, di, N), torch.float32,
                                            "log_range"),
                          "out_proj": normal(n, di, d),
                          "dskip": full(n, di)}
        if cfg.moe:
            E = cfg.moe.n_experts
            lay["moe"] = {"router": normal(n, d, E, dtype=torch.float32),
                          "wg": normal(n, E, d, f), "wu": normal(n, E, d, f),
                          "wo": normal(n, E, f, d)}
        else:
            lay["mlp"] = {"wu": normal(n, d, f), "wo": normal(n, f, d)}
            if cfg.act == "swiglu":
                lay["mlp"]["wg"] = normal(n, d, f)
        return params

    def init_params(self, seed: int) -> dict:
        """Weights by ``param_layout``, the normal ones drawn by a generator
        on the model's device seeded with ``seed``.  A stacked leaf is
        drawn one layer at a time, so the float32 temporary is one
        layer's slice, never a whole leaf."""
        generator = torch.Generator(device=self.device).manual_seed(seed)

        def make(spec: ParamSpec) -> torch.Tensor:
            if spec.init == "full":
                return torch.full(spec.shape, spec.value, dtype=spec.dtype,
                                  device=self.device)
            if spec.init == "log_range":     # log(1..N) along the last axis
                r = torch.arange(1, spec.shape[-1] + 1, dtype=spec.dtype,
                                 device=self.device)
                return torch.log(r).expand(spec.shape).contiguous()
            out = torch.empty(spec.shape, dtype=spec.dtype,
                              device=self.device)
            for part in (out if len(spec.shape) > 2 else (out,)):
                part.copy_(torch.randn(part.shape, generator=generator,
                                       device=self.device).mul_(spec.value))
            return out

        return map_params(make, self.param_layout())

    # ---- sublayers -------------------------------------------------------------

    def _attn(self, lp, h, positions, cache=None, pos=None):
        cfg = self.cfg
        B, Sq, _ = h.shape
        hd, Hq, Hkv = cfg.head_dim, cfg.n_heads_padded, cfg.n_kv_heads
        q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
        if cfg.qkv_bias:
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = q.reshape(B, Sq, Hq, hd)
        k = k.reshape(B, Sq, Hkv, hd)
        v = v.reshape(B, Sq, Hkv, hd)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)

        if cache is None or Sq > 1:                     # forward / prefill
            if cache is not None:
                cache["k"][:, :Sq] = k
                cache["v"][:, :Sq] = v
            out = L.flash_attention(q, k, v, causal=True,
                                    window=cfg.sliding_window,
                                    q_chunk=self.q_chunk,
                                    kv_chunk=self.kv_chunk)
        else:                                           # single-token decode
            T = cache["k"].shape[1]
            idx = pos % T                               # circular buffer
            cache["k"][:, idx] = k[:, 0]
            cache["v"][:, idx] = v[:, 0]
            # the reference masks by n_valid only: with capacity > window
            # decode attends past the sliding window (ROADMAP, LM module)
            n_valid = min(pos + 1, T)
            valid = (torch.arange(T, device=h.device) < n_valid)[None, :]
            out = L.decode_attention(q, cache["k"], cache["v"],
                                     valid.expand(B, T))
        return out.reshape(B, Sq, Hq * hd) @ lp["wo"]

    def _ffn(self, lp, h):
        """The MLP, or on MoE layers the routed experts; returns (y, the
        load-balance loss, 0.0 without experts)."""
        cfg = self.cfg
        if cfg.moe:
            return L.moe_apply(lp["moe"], h, n_experts=cfg.moe.n_experts,
                               top_k=cfg.moe.top_k,
                               capacity_factor=cfg.moe.capacity_factor,
                               act=cfg.act)
        return L.mlp_apply(lp["mlp"], h, cfg.act), 0.0

    def _layer(self, lp, x, positions, cache=None, pos=None):
        """One block. Returns (x, aux); the layer's cache, when given, is
        updated in place."""
        cfg = self.cfg
        if cfg.block == "rwkv":
            return self._rwkv_layer(lp, x, cache), 0.0
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        mix = self._attn(lp, h, positions, cache=cache, pos=pos)
        if cfg.block == "hybrid":        # the SSM heads on the same input
            st = (None, None) if cache is None else (cache["ssm_state"],
                                                      cache["conv"])
            y, (state, conv) = SSM.ssm_apply(lp["ssm"], h, state=st[0],
                                             conv_carry=st[1])
            mix = mix + y
            if cache is not None:
                cache["ssm_state"].copy_(state)
                cache["conv"].copy_(conv)
        x = x + mix
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, aux = self._ffn(lp, h)
        return x + y, aux

    def _rwkv_layer(self, lp, x, cache=None):
        """RWKV-6: time mixing, then channel mixing, each on its own normed
        input and token-shift row."""
        cfg = self.cfg
        B, d = x.shape[0], cfg.d_model
        H, hd = d // SSM.RWKV_HEAD_DIM, SSM.RWKV_HEAD_DIM
        if cache is None:
            sx0 = sx1 = torch.zeros((B, d), dtype=x.dtype, device=x.device)
            st0 = torch.zeros((B, H, hd, hd), dtype=torch.float32,
                              device=x.device)
        else:
            sx0, sx1, st0 = cache["sx_att"], cache["sx_ffn"], cache["wkv"]
        h = L.rms_norm(x, lp["ln1"], cfg.norm_eps)
        y, sx_att, wkv = SSM.rwkv_time_mix(lp["rwkv"]["att"], h, sx0, st0)
        x = x + y
        h = L.rms_norm(x, lp["ln2"], cfg.norm_eps)
        y, sx_ffn = SSM.rwkv_channel_mix(lp["rwkv"]["ffn"], h, sx1)
        if cache is not None:
            cache["wkv"].copy_(wkv)
            cache["sx_att"].copy_(sx_att)
            cache["sx_ffn"].copy_(sx_ffn)
        return x + y

    def _layers(self, params, x, positions, cache=None, pos=None):
        """The layer stack. Returns (x, the mean of the layers' aux)."""
        auxs = []
        for i in range(self.cfg.n_layers):
            lp = map_params(lambda t: t[i], params["layers"])
            if cache is None and self.remat and torch.is_grad_enabled():
                x, aux = checkpoint(self._layer, lp, x, positions,
                                    use_reentrant=False)
            else:
                cl = None if cache is None else map_params(
                    lambda t: t[i], cache["layers"])
                x, aux = self._layer(lp, x, positions, cache=cl, pos=pos)
            auxs.append(aux)
        return x, (torch.stack(auxs).mean() if self.cfg.moe else 0.0)

    # ---- embeddings / logits ----------------------------------------------------

    def _embed(self, params, tokens, embeds):
        """``[embeds (cast to the model's dtype), token embeddings]``
        along the sequence; either may be None."""
        xs = []
        if embeds is not None:
            xs.append(embeds.to(self.dtype))
        if tokens is not None:
            xs.append(params["embed"][tokens.long()])
        return torch.cat(xs, dim=1) if len(xs) > 1 else xs[0]

    def _head(self, params):
        """(D, Vp): ``embed.T`` with tied embeddings, else ``lm_head``."""
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    def _logits(self, params, x):
        x = L.rms_norm(x, params["final_norm"], self.cfg.norm_eps)
        return x @ self._head(params)

    # ---- entry points -------------------------------------------------------------

    def _backbone(self, params, tokens=None, embeds=None):
        """Embed + layer stack + final norm. Returns (x (B, S, D), aux)."""
        x = self._embed(params, tokens, embeds)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x, aux = self._layers(params, x, positions)
        return L.rms_norm(x, params["final_norm"], self.cfg.norm_eps), aux

    def forward(self, params: dict, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None):
        """Train/eval forward (differentiable). Returns (logits (B, S,
        Vp) over the frames and the tokens, moe aux loss: the layers'
        mean, a float32 scalar; 0.0 without experts)."""
        x, aux = self._backbone(params, tokens, embeds)
        return x @ self._head(params), aux

    def forward_loss(self, params: dict, tokens: torch.Tensor | None,
                     labels: torch.Tensor,
                     loss_mask: torch.Tensor | None = None,
                     embeds: torch.Tensor | None = None,
                     loss_chunk: int = 512):
        """Fused chunked cross-entropy: never materializes (B, S, Vp)
        logits.  The head matmul and the CE run one sequence chunk at a
        time under ``torch.utils.checkpoint``, so the backward recomputes
        each chunk's logits instead of saving them.  ``labels`` and
        ``loss_mask`` span the whole stream, frames included.  Returns
        (mean masked NLL, moe aux loss as ``forward``'s)."""
        x, aux = self._backbone(params, tokens, embeds)
        head = self._head(params)
        S = x.shape[1]
        c = min(loss_chunk, S)
        if S % c:
            raise ValueError(f"sequence {S} is not a multiple of the loss "
                             f"chunk {c}")
        if loss_mask is None:
            loss_mask = torch.ones(labels.shape, dtype=torch.float32,
                                   device=x.device)

        def body(xc, lc, mc):
            return _chunk_ce(xc @ head, lc, mc, self.cfg.vocab)

        nll = msum = 0.0
        for s0 in range(0, S, c):
            part = (x[:, s0:s0 + c], labels[:, s0:s0 + c],
                    loss_mask[:, s0:s0 + c])
            n, m = (checkpoint(body, *part, use_reentrant=False)
                    if torch.is_grad_enabled() else body(*part))
            nll, msum = nll + n, msum + m
        return nll / torch.clamp(msum, min=1.0), aux

    def init_cache(self, batch: int, capacity: int) -> dict:
        """Zeros: the KV cache (attention blocks), the SSM's float32 state
        and conv carry (hybrid), or RWKV's float32 WKV state and its two
        token-shift rows (rwkv), each stacked over the layers."""
        cfg, n = self.cfg, self.cfg.n_layers

        def zeros(*shape, dtype=self.dtype):
            return torch.zeros((n, batch, *shape), dtype=dtype,
                               device=self.device)

        c = {}
        if cfg.block in ("attn", "hybrid"):
            c["k"] = zeros(capacity, cfg.n_kv_heads, cfg.head_dim)
            c["v"] = zeros(capacity, cfg.n_kv_heads, cfg.head_dim)
        if cfg.block == "hybrid":
            di = cfg.ssm.expand * cfg.d_model
            c["ssm_state"] = zeros(di, cfg.ssm.state_dim,
                                   dtype=torch.float32)
            c["conv"] = zeros(cfg.ssm.conv_width - 1, di)
        if cfg.block == "rwkv":
            H, hd = cfg.d_model // SSM.RWKV_HEAD_DIM, SSM.RWKV_HEAD_DIM
            c["wkv"] = zeros(H, hd, hd, dtype=torch.float32)
            c["sx_att"] = zeros(cfg.d_model)
            c["sx_ffn"] = zeros(cfg.d_model)
        return {"layers": c, "pos": 0}

    @torch.no_grad()
    def prefill(self, params: dict, tokens: torch.Tensor | None = None,
                embeds: torch.Tensor | None = None,
                capacity: int | None = None):
        """Forward pass that also populates the cache. Returns (logits of
        the last position (B, 1, Vp), cache); the prompt is the frames
        and the tokens, so the capacity and ``pos`` count both."""
        x = self._embed(params, tokens, embeds)
        B, Sq = x.shape[0], x.shape[1]
        capacity = capacity or Sq
        if capacity < Sq:
            raise ValueError(f"cache capacity {capacity} < prompt {Sq}")
        cache = self.init_cache(B, capacity)
        positions = torch.arange(Sq, device=x.device)[None, :]
        x, _ = self._layers(params, x, positions, cache=cache, pos=0)
        cache["pos"] = Sq
        return self._logits(params, x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, params: dict, cache: dict, tokens: torch.Tensor):
        """One decode step. tokens: (B, 1). Returns (logits (B, 1, Vp),
        cache), the cache's tensors updated in place."""
        x = self._embed(params, tokens, None)
        pos = int(cache["pos"])
        positions = torch.full((x.shape[0], 1), pos, device=x.device)
        x, _ = self._layers(params, x, positions, cache=cache, pos=pos)
        return self._logits(params, x), {"layers": cache["layers"],
                                         "pos": pos + 1}


# ---- loss -------------------------------------------------------------------

def _live_logits(logits: torch.Tensor, vocab: int | None) -> torch.Tensor:
    """float32 logits with the vocab padding at -1e9."""
    logits = logits.float()
    if vocab is not None and vocab < logits.shape[-1]:
        live = torch.arange(logits.shape[-1], device=logits.device) < vocab
        logits = torch.where(live, logits, -1e9)
    return logits


def _nll(logits, labels, vocab):
    logits = _live_logits(logits, vocab)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - ll


def _chunk_ce(logits, labels, mask, vocab: int | None):
    """Summed masked CE over one chunk. Returns (sum_nll, sum_mask)."""
    mask = mask.float()
    return (_nll(logits, labels, vocab) * mask).sum(), mask.sum()


def lm_loss(logits, labels, mask=None, vocab: int | None = None):
    """Mean next-token cross-entropy. logits: (B, S, Vp), labels: (B, S)."""
    nll = _nll(logits, labels, vocab)
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


# ---- parameter trees --------------------------------------------------------

def map_params(fn, tree: dict) -> dict:
    """``fn`` applied to every leaf of a parameter (or cache) tree."""
    return {k: map_params(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_leaves(tree: dict) -> list:
    """The leaves in the reference's pytree order (dict keys sorted)."""
    return [x for k in sorted(tree) for x in (
        tree_leaves(tree[k]) if isinstance(tree[k], dict) else (tree[k],))]


def tree_unflatten(tree: dict, leaves) -> dict:
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order)."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}
    return build(tree)


# ---- weights from and to the JAX package ------------------------------------------

def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(np.asarray(a))
    if a.dtype.name == "bfloat16":           # ml_dtypes: carry the bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                      # only where JAX's dtypes are
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_jax(tree: dict, device: str | torch.device = "cpu") -> dict:
    """The port's parameters from a JAX ``LM`` parameter pytree (leaves as
    numpy arrays), bit for bit, in the same layout and dtypes."""
    return map_params(lambda a: _leaf_to_torch(a, device), tree)


def params_to_jax(params: dict) -> dict:
    """The JAX parameter pytree (numpy leaves) of the port's parameters;
    inverse of ``params_from_jax``."""
    return map_params(_leaf_to_numpy, params)
