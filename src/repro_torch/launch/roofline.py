"""Roofline terms on the NVIDIA H100's peaks.

The counterpart of ``repro/launch/roofline.py``, with the constants of the
card the port runs on ("NVIDIA H100 80GB HBM3, 700.00 W", as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` names
it); no TPU constant remains.  Terms per (arch, shape, device count), all
per device:

  compute_s    = FLOPs / PEAK_FLOPS      (989 TFLOP/s bf16 dense, tensor cores)
  memory_s     = bytes / HBM_BW          (3.35 TB/s HBM3)
  collective_s = wire_bytes / LINK_BW    (NVLink 4: 450 GB/s each direction)

all from the H100 SXM data sheet.  ``model_flops`` is the analytic 6 N D
(train) or 2 N D (prefill, decode) over the active parameters; over a
measured step's seconds and ``PEAK_FLOPS`` it gives the model FLOP
utilisation (``mfu``) that the smoke prints beside each LM time.

``collective_wire_bytes`` is pure text parsing of post-SPMD XLA HLO: it
has no torch input, and the port keeps it so that the reference's
dry-run records can be read with the card's link rate; its ring formulas
(``ring_wire_bytes``) are what ``launch/dryrun`` applies to the
collectives it traces.
``extrapolate`` is the reference's two-point layer extrapolation,
metric(L) = m(1) + (L - 1) (m(2) - m(1)), exact for homogeneous stacks.
"""

from __future__ import annotations

import dataclasses
import re

PEAK_FLOPS = 989e12       # H100 SXM bf16 tensor cores, dense
HBM_BW = 3.35e12          # H100 SXM HBM3, bytes/s
NVLINK_BW = 450e9         # NVLink 4, bytes/s in each direction

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "tuple": 0, "token": 0,
}

_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\)|[a-z0-9]+\[[0-9,]*\])[^\s]*)\s+"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(", re.M)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_GROUPS_RE = re.compile(r"replica_groups=\{?\{([0-9, ]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(type_str):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_wire_bytes(hlo_text: str, default_group: int) -> dict:
    """Per-device ring wire bytes by collective kind, from HLO text."""
    out = {"all-gather": 0.0, "all-reduce": 0.0, "reduce-scatter": 0.0,
           "all-to-all": 0.0, "collective-permute": 0.0}
    for m in _COLL_RE.finditer(hlo_text):
        type_str, kind = m.group(1), m.group(2)
        size = _shape_bytes(type_str)
        tail = hlo_text[m.end():m.end() + 600]
        g = _GROUPS_RE.search(tail)
        gi = _GROUPS_IOTA_RE.search(tail)
        if g:
            D = len(g.group(1).split(","))
        elif gi:
            D = int(gi.group(2))
        else:
            D = default_group
        out[kind] += ring_wire_bytes(kind, size, D)
    return out


def ring_wire_bytes(kind: str, size: float, group: int) -> float:
    """Per-device ring wire bytes of one collective of ``kind`` whose
    result is ``size`` bytes a device, over a group of ``group`` ranks
    (the formulas ``collective_wire_bytes`` applies to each HLO
    collective, and ``launch/dryrun`` to each traced one)."""
    D = max(group, 1)
    frac = (D - 1) / D
    if kind == "all-gather":
        return size * frac                  # result = gathered full
    if kind == "reduce-scatter":
        return size * D * frac              # result = scattered shard
    if kind == "all-reduce":
        return 2 * size * frac
    if kind == "all-to-all":
        return size * frac
    return size                             # collective-permute


@dataclasses.dataclass
class RooflineTerms:
    hlo_flops: float            # per device
    hlo_bytes: float            # per device
    wire_bytes: float           # per device
    wire_by_kind: dict
    model_flops: float          # global analytic 6*N*D
    n_devices: int

    @property
    def compute_s(self):
        return self.hlo_flops / PEAK_FLOPS

    @property
    def memory_s(self):
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self):
        return self.wire_bytes / NVLINK_BW

    @property
    def dominant(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self):
        global_hlo = self.hlo_flops * self.n_devices
        return self.model_flops / global_hlo if global_hlo else 0.0

    def as_dict(self):
        return {
            "hlo_flops_per_dev": self.hlo_flops,
            "hlo_bytes_per_dev": self.hlo_bytes,
            "wire_bytes_per_dev": self.wire_bytes,
            "wire_by_kind": self.wire_by_kind,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "n_devices": self.n_devices,
        }


def extrapolate(m1: float, m2: float, n_layers: int) -> float:
    return m1 + (n_layers - 1) * (m2 - m1)


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode processes B tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2.0
    else:
        tokens = shape.global_batch
        mult = 2.0
    return mult * n * tokens


def mfu(cfg, shape, seconds: float) -> float:
    """Model FLOP utilisation: ``model_flops`` over ``seconds`` at
    ``PEAK_FLOPS``, for one device."""
    return model_flops(cfg, shape) / (seconds * PEAK_FLOPS)
