"""Registry of the assigned architectures: the counterpart of
``repro.configs``, the same 10 archs in the same order.

The four dense decoders: h2o-danube-1.8b (sliding window), qwen2.5-14b
(QKV biases), phi4-mini-3.8b (tied embeddings) and granite-34b (MQA);
the two MoE decoders: dbrx-132b (16 experts, top-4) and olmoe-1b-7b (64
experts, top-8); hymba-1.5b (attention and a selective SSM in parallel)
and rwkv6-1.6b (RWKV-6); and the two frontend archs, llava-next-34b
(VLM: 2304 anyres patch embeddings) and musicgen-large (audio: 256 frame
embeddings), whose encoders are stubs: precomputed embeddings are
prepended to the token embeddings (``LM._embed``).  The paper's own DLRM
recommender is ``repro_torch.configs.dlrm``.
"""

from repro_torch.configs import (
    dbrx_132b, granite_34b, h2o_danube_1p8b, hymba_1p5b, llava_next_34b,
    musicgen_large, olmoe_1b_7b, phi4_mini_3p8b, qwen2p5_14b, rwkv6_1p6b,
)
from repro_torch.configs.shapes import (INPUT_SHAPES, InputShape,  # noqa: F401
                                        input_specs)

_MODULES = {
    "llava-next-34b": llava_next_34b,
    "hymba-1.5b": hymba_1p5b,
    "qwen2.5-14b": qwen2p5_14b,
    "dbrx-132b": dbrx_132b,
    "granite-34b": granite_34b,
    "phi4-mini-3.8b": phi4_mini_3p8b,
    "olmoe-1b-7b": olmoe_1b_7b,
    "rwkv6-1.6b": rwkv6_1p6b,
    "h2o-danube-1.8b": h2o_danube_1p8b,
    "musicgen-large": musicgen_large,
}

ARCH_NAMES = tuple(_MODULES)

# sub-quadratic archs that can serve the 524k-token decode shape
LONG_CONTEXT_ARCHS = ("rwkv6-1.6b", "hymba-1.5b", "h2o-danube-1.8b")


def _module(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; the registry holds "
                       f"{ARCH_NAMES}")
    return _MODULES[name]


def get_full(name: str):
    return _module(name).FULL


def get_smoke(name: str):
    return _module(name).SMOKE


def supports_shape(name: str, shape_name: str) -> bool:
    if shape_name == "long_500k":
        return name in LONG_CONTEXT_ARCHS
    return True
