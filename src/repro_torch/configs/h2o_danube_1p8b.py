"""h2o-danube-1.8b [dense] -- 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000, llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]

SWA (window 4096) makes this the one *dense* arch that runs `long_500k`:
the decode cache is a circular window buffer, O(window) not O(seq).
"""

from repro_torch.models.config import ArchConfig

FULL = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000,
    sliding_window=4096, act="swiglu",
    source="arXiv:2401.16818",
)

SMOKE = ArchConfig(
    name="h2o-danube-1.8b-smoke", family="dense",
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
    d_ff=512, vocab=512,
    sliding_window=64, act="swiglu",
    source="reduced variant of h2o-danube-1.8b",
)
