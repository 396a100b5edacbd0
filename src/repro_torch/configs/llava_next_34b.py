"""llava-next-34b [vlm] -- 60L d_model=7168 56H (GQA kv=8) d_ff=20480
vocab=64000, anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf]

The ViT/SigLIP vision encoder + projector is a STUB: ``input_specs`` provides
precomputed anyres patch embeddings of shape (B, 2304, d_model); the config
here describes the language backbone that consumes them.
"""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000,
    rope_theta=1e6, act="swiglu",
    frontend="vlm", n_frontend_tokens=2304,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE = ArchConfig(
    name="llava-next-34b-smoke", family="vlm",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
    rope_theta=1e6, act="swiglu",
    frontend="vlm", n_frontend_tokens=16,
    source="reduced variant of llava-next-34b",
)
