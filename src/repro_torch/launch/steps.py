"""Model and step constructors for serving: prefill and decode.

The counterpart of ``build_model``, ``make_prefill_step`` and
``make_decode_step`` in ``repro/launch/steps.py``.  PyTorch runs eagerly,
so a step is the model call itself; the train step and the sharded
lowering wait for their slices (ROADMAP queue, LM substrate).
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import LM


def build_model(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device | None = None) -> LM:
    """An ``LM`` on ``device`` (default ``cuda``; raises without a card)."""
    return LM(cfg, dtype=dtype, device=device)


def make_prefill_step(model: LM, capacity: int | None = None):
    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"], capacity=capacity)
    return prefill_step


def make_decode_step(model: LM):
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch["tokens"])
    return decode_step
