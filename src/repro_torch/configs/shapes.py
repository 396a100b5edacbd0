"""Assigned input shapes and ``input_specs()`` stand-ins.

The counterpart of ``repro/configs/shapes.py``.  ``input_specs`` returns,
for every model input of a given (arch, shape) pair, a tensor on the
``meta`` device: it has a shape and a dtype and allocates nothing.  A
meta tensor is a shape stand-in, the port's analogue of the reference's
``ShapeDtypeStruct``; it is not a device that ``resolve_device`` hands
out, and no entry point runs on it.  For VLM/audio archs the modality
frontend is a stub: the specs include a precomputed patch/frame embedding
tensor of the right shape and the token span shrinks accordingly.
``batch_specs_partition`` gives each input's ``PartitionSpec`` under a
``ShardingRules`` (batch over the data axes).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ArchConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def sds(shape, dtype: torch.dtype) -> torch.Tensor:
    """A shape stand-in: an empty tensor on the ``meta`` device."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: InputShape,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Meta-tensor stand-ins for the model inputs of one step.

    train   -> {tokens, labels, loss_mask [, embeds]}
    prefill -> {tokens [, embeds]}
    decode  -> {tokens}  (the cache comes from ``LM.init_cache``)
    """
    B, S = shape.global_batch, shape.seq_len
    nf = cfg.n_frontend_tokens if cfg.frontend else 0
    if shape.kind == "train":
        specs = {"tokens": sds((B, S - nf), torch.int32),
                 "labels": sds((B, S), torch.int32),
                 "loss_mask": sds((B, S), torch.float32)}
        if nf:
            specs["embeds"] = sds((B, nf, cfg.d_model), dtype)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": sds((B, S - nf), torch.int32)}
        if nf:
            specs["embeds"] = sds((B, nf, cfg.d_model), dtype)
        return specs
    if shape.kind == "decode":
        return {"tokens": sds((B, 1), torch.int32)}
    raise ValueError(shape.kind)


def batch_specs_partition(cfg: ArchConfig, shape: InputShape, rules):
    """PartitionSpecs matching input_specs (batch over data axes)."""
    specs = {}
    for name in input_specs(cfg, shape):
        rank = {"tokens": 2, "labels": 2, "loss_mask": 2, "embeds": 3}[name]
        specs[name] = rules.spec("batch", *([None] * (rank - 1)))
    return specs
