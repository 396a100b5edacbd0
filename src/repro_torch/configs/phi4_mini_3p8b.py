"""phi4-mini-3.8b [dense] -- 32L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=200064, RoPE + SwiGLU + GQA.  [arXiv:2412.08905]
"""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=200064,
    rope_theta=1e4, act="swiglu", tie_embeddings=True,
    source="arXiv:2412.08905",
)

SMOKE = ArchConfig(
    name="phi4-mini-3.8b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=4,
    d_ff=512, vocab=512,
    act="swiglu", tie_embeddings=True,
    source="reduced variant of phi4-mini-3.8b",
)
