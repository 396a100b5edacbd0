"""The kernels' path through a fake trace.

A trace on fake tensors (``FakeTensorMode``, as ``launch/dryrun`` runs
one) has shapes and no data: no kernel can launch and no plain version
can compute.  So each kernel op has a stand-in: a custom op in the
``repro_torch`` namespace whose fake implementation returns outputs of
the kernel's shapes and dtypes and computes nothing, and whose FLOP
formula (``torch.utils.flop_counter``) is the one the kernel's bound in
PERF.md counts.  A wrapper calls it only where an input is a fake or a
meta tensor (``traced``).  It is not a fallback: the stand-in has no
implementation for a real tensor (calling it on one raises), and on real
tensors the wrappers launch the kernel (CUDA) or run the plain version
(CPU) as they did before.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

_LIB = torch.library.Library("repro_torch", "FRAGMENT")


def traced(*ts) -> bool:
    """True where any of ``ts`` is a fake or a meta tensor."""
    return any(isinstance(t, torch.Tensor)
               and (isinstance(t, FakeTensor) or t.is_meta) for t in ts)


def define(schema: str, fake, flops):
    """The stand-in ``repro_torch::<name>`` of ``schema``: ``fake`` gives
    its outputs' shapes and dtypes, ``flops`` (the inputs' shapes, the
    other arguments, ``out_shape=``) its FLOP count.  Returns the op."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    packet = getattr(torch.ops.repro_torch, name)
    register_flop_formula(packet)(flops)
    return packet.default
