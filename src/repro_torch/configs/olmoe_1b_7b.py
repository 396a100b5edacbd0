"""olmoe-1b-7b [moe] -- 16L d_model=2048 16H (GQA kv=16, i.e. MHA)
d_ff=1024 vocab=50304, MoE 64 experts top-8.  [arXiv:2409.02060]

The fine-grained 64-expert/top-8 configuration is where expert-placement
balance matters most (4 experts per model shard at the reference's
tp=16, as the port splits them over a model axis of 16 ranks).
"""

from repro_torch.models.config import ArchConfig, MoEConfig

FULL = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8), act="swiglu",
    source="arXiv:2409.02060",
)

SMOKE = ArchConfig(
    name="olmoe-1b-7b-smoke", family="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2), act="swiglu",
    source="reduced variant of olmoe-1b-7b",
)
