"""rwkv6-1.6b [ssm] -- 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536, Finch: data-dependent decay.  [arXiv:2404.05892]

Attention-free linear recurrence: decode carries a (H, 64, 64) wkv state
per layer, so `long_500k` costs O(1) memory in sequence length.
"""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=7168, vocab=65536,
    block="rwkv",
    source="arXiv:2404.05892",
)

SMOKE = ArchConfig(
    name="rwkv6-1.6b-smoke", family="ssm",
    n_layers=2, d_model=256, n_heads=0, n_kv_heads=0,
    d_ff=512, vocab=512,
    block="rwkv",
    source="reduced variant of rwkv6-1.6b",
)
