"""Device selection: the GPU unless the caller names the CPU.

There is no silent fallback.  ``resolve_device()`` with no argument means
``cuda``, and raises where there is no card, so a run that was meant for
the GPU never carries on on the CPU unnoticed.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises ``RuntimeError`` for a CUDA device when no card is visible.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
