"""DreamShard in PyTorch for NVIDIA GPUs.

The counterpart of the JAX package ``repro``: the same subpackage and
module names, PyTorch inside, and hand-written CUDA kernels where the JAX
package has Pallas ones.  It imports nothing of ``repro`` or ``jax``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``repro_torch.device``).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
