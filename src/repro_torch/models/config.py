"""Architecture configuration of the LM substrate.

A copy of ``repro/models/config.py`` (the port imports nothing of
``repro``).  Each architecture module in ``repro_torch.configs`` exports a
``FULL`` ArchConfig (exact published shape) and a ``SMOKE`` reduced
variant for CPU tests.  ``resolve(tp)`` adapts head counts to a
tensor-parallel degree: query heads are padded to a multiple of tp and
KV heads replicated up to tp when smaller (a padded query head reads KV
head 0: ``models/transformer.LM.kv_map``).  ``resolve`` is a bitwise copy,
its quirk included: where the padded query heads are cut to a multiple of
the padded KV heads they may fall below ``n_heads`` (hymba-1.5b at tp 2
and 4), and ``LM`` refuses such a config.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                    # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0               # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    sliding_window: Optional[int] = None   # tokens; None = full attention
    block: str = "attn"             # attn | hybrid (attn+ssm) | rwkv
    act: str = "swiglu"             # swiglu | gelu
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[str] = None  # None | vlm | audio (stubbed embeddings)
    n_frontend_tokens: int = 0      # embeddings prepended by the stub
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    source: str = ""                # citation for the config

    # resolved sharding-dependent fields (set by resolve())
    tp: int = 1
    n_heads_padded: int = 0
    n_kv_padded: int = 0
    vocab_padded: int = 0

    def resolve(self, tp: int) -> "ArchConfig":
        """Bind the config to a tensor-parallel degree."""
        hd = self.head_dim or (self.d_model // max(self.n_heads, 1))
        nh = self.n_heads
        nkv = self.n_kv_heads
        nh_pad = math.ceil(nh / tp) * tp if nh else 0
        if nkv and nkv < tp:
            nkv_pad = tp                       # replicate KV heads across TP
        elif nkv:
            nkv_pad = math.ceil(nkv / tp) * tp
        else:
            nkv_pad = 0
        # query heads per kv group must stay integral after padding
        if nkv_pad:
            group = max(1, nh_pad // nkv_pad)
            nh_pad = group * nkv_pad
        vpad = math.ceil(self.vocab / tp) * tp
        assert self.d_ff % tp == 0, (self.name, self.d_ff, tp)
        return dataclasses.replace(
            self, tp=tp, head_dim=hd, n_heads_padded=nh_pad,
            n_kv_padded=nkv_pad, vocab_padded=vpad)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads_padded // max(self.n_kv_padded, 1)

    def param_count(self) -> int:
        """Approximate parameter count of the FULL (unpadded) architecture."""
        d, ff, v, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        hd = self.head_dim or (self.d_model // max(self.n_heads, 1))
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.block in ("attn", "hybrid"):
            per_layer += d * hd * self.n_heads + hd * self.n_heads * d  # q, o
            per_layer += 2 * d * hd * self.n_kv_heads                   # k, v
        if self.block == "hybrid" and self.ssm:
            di = self.ssm.expand * d
            per_layer += d * 2 * di + di * d + di * self.ssm.state_dim * 2
        if self.block == "rwkv":
            per_layer += 6 * d * d
        n_ffn = 3 if self.act == "swiglu" else 2
        if self.moe:
            per_layer += d * self.moe.n_experts  # router
            per_layer += self.moe.n_experts * n_ffn * d * ff
        else:
            per_layer += n_ffn * d * ff
        return emb + L * per_layer

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.moe:
            return self.param_count()
        full = self.param_count()
        n_ffn = 3 if self.act == "swiglu" else 2
        expert = n_ffn * self.d_model * self.d_ff
        inactive = self.n_layers * (self.moe.n_experts - self.moe.top_k) * expert
        return full - inactive
