"""granite-34b [dense] -- 88L d_model=6144 48H (GQA kv=1, i.e. MQA)
d_ff=24576 vocab=49152, llama-arch code model.  [arXiv:2405.04324]

MQA: the single KV head is replicated across tensor-parallel shards; the
decode KV cache is sharded over the sequence axis instead
(sequence-parallel decode attention).
"""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152,
    act="gelu", tie_embeddings=False,
    source="arXiv:2405.04324",
)

SMOKE = ArchConfig(
    name="granite-34b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=1,
    d_ff=512, vocab=512,
    act="gelu",
    source="reduced variant of granite-34b",
)
