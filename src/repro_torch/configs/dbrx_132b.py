"""dbrx-132b [moe] -- 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16 experts top-4 (fine-grained).  [hf:databricks/dbrx-base]

Sort-based capacity dispatch; the reference shards the experts over the
model axis (1 expert per shard at tp=16), and so does the port.
"""

from repro_torch.models.config import ArchConfig, MoEConfig

FULL = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab=100352,
    moe=MoEConfig(n_experts=16, top_k=4), act="swiglu",
    source="hf:databricks/dbrx-base",
)

SMOKE = ArchConfig(
    name="dbrx-132b-smoke", family="moe",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
    moe=MoEConfig(n_experts=4, top_k=2), act="swiglu",
    source="reduced variant of dbrx-132b",
)
