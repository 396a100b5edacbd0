"""qwen2.5-14b [dense] -- 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064, GQA with QKV bias.  [hf:Qwen/Qwen2.5-0.5B]
"""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="qwen2.5-14b", family="dense",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=13824, vocab=152064,
    qkv_bias=True, rope_theta=1e6, act="swiglu",
    source="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE = ArchConfig(
    name="qwen2.5-14b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
    qkv_bias=True, rope_theta=1e6, act="swiglu",
    source="reduced variant of qwen2.5-14b",
)
