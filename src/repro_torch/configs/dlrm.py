"""DLRM recommender -- the paper's own architecture [arXiv:1906.00091,
Meta DLRM; table statistics follow the open-sourced DLRM dataset, App. C].

The counterpart of ``repro/configs/dlrm.py``.  Unlike the LM pool,
DLRM's placement-relevant inputs are the embedding tables themselves; its
training shape is one step at production batch 65536 with DreamShard-
placed tables.  Imported directly (``repro_torch.configs.dlrm``): the
registry in ``repro_torch.configs`` holds LM archs only.
"""

from repro_torch.models.dlrm import DLRMConfig

FULL = DLRMConfig(
    n_dense_features=13,
    embed_dim=128,              # 16-dim tables padded to one 128 lane tile
    bottom_mlp=(512, 256),
    top_mlp=(1024, 512, 256),
    n_tables=200,
)

SMOKE = DLRMConfig(
    n_dense_features=4,
    embed_dim=128,
    bottom_mlp=(32,),
    top_mlp=(64, 32),
    n_tables=8,
)

TRAIN_BATCH = 65536
SMOKE_BATCH = 64
