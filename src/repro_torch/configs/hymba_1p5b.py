"""hymba-1.5b [hybrid] -- 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16, parallel attn+mamba heads.  [arXiv:2411.13676]

Each block runs attention (sliding-window) and a selective-SSM branch in
parallel on the same normed input -- the hybrid-head structure of Hymba.
Sub-quadratic (SWA + SSM state), so `long_500k` runs for this arch.
"""

from repro_torch.models.config import ArchConfig, SSMConfig

FULL = ArchConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab=32001,
    sliding_window=1024, block="hybrid",
    ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
    act="swiglu",
    source="arXiv:2411.13676",
)

SMOKE = ArchConfig(
    name="hymba-1.5b-smoke", family="hybrid",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab=512,
    sliding_window=64, block="hybrid",
    ssm=SSMConfig(state_dim=8, conv_width=4, expand=2),
    act="swiglu",
    source="reduced variant of hymba-1.5b",
)
