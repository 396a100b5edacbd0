"""Architectures the port serves so far: the counterpart of
``repro.configs`` for the archs whose blocks the port's ``LM`` runs.

Only h2o-danube-1.8b (dense attention with a sliding window) for now; the
other archs of the JAX registry wait for their blocks (ROADMAP queue).
"""

from repro_torch.configs import h2o_danube_1p8b
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape  # noqa: F401

_MODULES = {
    "h2o-danube-1.8b": h2o_danube_1p8b,
}

ARCH_NAMES = tuple(_MODULES)


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"the port does not serve {name!r} yet; it serves "
                       f"{ARCH_NAMES}")
    return _MODULES[name]


def get_full(name: str):
    return _module(name).FULL


def get_smoke(name: str):
    return _module(name).SMOKE
